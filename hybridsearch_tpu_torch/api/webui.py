"""Web UIs (the port of ``hybridsearch_tpu/api/webui.py``).

Two frontends with the reference ui.py's capability surface (search box +
weight sliders + feedback buttons, index tab, stats tab, watcher controls;
reference ui.py:94-258):

  - `HTML_PAGE`: a zero-dependency single-page UI served by the stdlib
    server at GET / — works where streamlit is not installed;
  - `streamlit_app()`: a Streamlit app (run with
    `streamlit run -m hybridsearch_tpu_torch.api.webui`) for parity with the
    reference's stack when streamlit is installed. Talks HTTP to API_URL
    like the reference (ui.py:11).
"""

from __future__ import annotations

import os

HTML_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>hybridsearch_tpu_torch</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:880px;margin:2rem auto;padding:0 1rem;color:#222}
 h1{font-size:1.4rem} .muted{color:#777;font-size:.85rem}
 input[type=text]{width:60%;padding:.5rem;font-size:1rem}
 button{padding:.5rem .9rem;margin-left:.3rem;cursor:pointer}
 .result{border:1px solid #ddd;border-radius:8px;padding:.7rem .9rem;margin:.5rem 0}
 .score{color:#0a7;font-weight:600;margin-right:.5rem}
 .docid{color:#999;font-size:.8rem;margin-left:.5rem}
 .fb{float:right}.fb button{font-size:.9rem}
 label{font-size:.85rem;color:#555;margin-right:1rem}
 pre{background:#f6f6f6;padding:.8rem;border-radius:8px;overflow:auto}
 nav button{margin-right:.4rem}
 section{display:none}section.active{display:block}
 mark{background:#ffe48a}
</style></head><body>
<h1>hybridsearch_tpu_torch <span class="muted">hybrid search on PyTorch and CUDA</span></h1>
<nav>
 <button onclick="show('search')">Search</button>
 <button onclick="show('index')">Index</button>
 <button onclick="show('stats')">Stats</button>
</nav>
<section id="search" class="active">
 <p>
  <input id="q" type="text" placeholder="query..." onkeydown="if(event.key==='Enter')doSearch()">
  <button onclick="doSearch()">Search</button>
 </p>
 <p>
  <label>semantic <input id="sw" type="range" min="0" max="100" value="70"
    oninput="document.getElementById('lw').value=100-this.value;upd()"></label>
  <label>lexical <input id="lw" type="range" min="0" max="100" value="30"
    oninput="document.getElementById('sw').value=100-this.value;upd()"></label>
  <span id="wlabel" class="muted">0.70 / 0.30</span>
 </p>
 <div id="results"></div>
</section>
<section id="index">
 <p><textarea id="doc" rows="5" cols="70" placeholder="document text..."></textarea></p>
 <p><button onclick="addDoc()">Add document</button></p>
 <p><input id="dir" type="text" placeholder="/path/to/docs">
    <button onclick="indexDir()">Index directory</button>
    <button onclick="watch(true)">Start watcher</button>
    <button onclick="watch(false)">Stop watcher</button></p>
 <div id="indexout" class="muted"></div>
</section>
<section id="stats"><pre id="statsout">loading...</pre></section>
<script>
const api = "";
function show(id){
 document.querySelectorAll('section').forEach(s=>s.classList.remove('active'));
 document.getElementById(id).classList.add('active');
 if(id==='stats') loadStats();
}
function upd(){
 const sw=document.getElementById('sw').value/100;
 document.getElementById('wlabel').textContent=sw.toFixed(2)+" / "+(1-sw).toFixed(2);
}
async function post(path, body){
 const r = await fetch(api+path,{method:'POST',headers:{'Content-Type':'application/json'},body:JSON.stringify(body)});
 return r.json();
}
async function doSearch(){
 const q=document.getElementById('q').value;
 const sw=document.getElementById('sw').value/100;
 const data=await post('/search/highlighted',{query:q,top_k:10,style:'html'});
 const div=document.getElementById('results'); div.innerHTML='';
 (data.results||[]).forEach(r=>{
  const el=document.createElement('div'); el.className='result';
  el.innerHTML=`<span class="fb">
    <button onclick="fb('${q.replace(/'/g,"\\'")}',${r.doc_id},1)">&#128077;</button>
    <button onclick="fb('${q.replace(/'/g,"\\'")}',${r.doc_id},-1)">&#128078;</button></span>
   <span class="score">${r.score.toFixed(4)}</span>${r.highlighted}
   <span class="docid">doc ${r.doc_id}</span>`;
  div.appendChild(el);
 });
 if(!(data.results||[]).length) div.innerHTML='<p class="muted">no results</p>';
}
async function fb(q,docId,rating){ await post('/feedback',{query:q,doc_id:docId,rating:rating}); }
async function addDoc(){
 const out=await post('/index/add',{documents:[document.getElementById('doc').value]});
 document.getElementById('indexout').textContent=JSON.stringify(out);
}
async function indexDir(){
 const out=await post('/index/directory',{directory:document.getElementById('dir').value});
 document.getElementById('indexout').textContent=JSON.stringify(out);
}
async function watch(start){
 const out=await post(start?'/watcher/start':'/watcher/stop',{directory:document.getElementById('dir').value});
 document.getElementById('indexout').textContent=JSON.stringify(out);
}
async function loadStats(){
 const r=await fetch(api+'/stats'); const s=await r.json();
 const c=await fetch(api+'/cache/stats'); const cs=await c.json();
 document.getElementById('statsout').textContent=JSON.stringify({stats:s,cache:cs},null,2);
}
</script></body></html>
"""


def streamlit_app() -> None:  # pragma: no cover - needs streamlit
    """Streamlit frontend (reference ui.py parity); requires streamlit."""
    import json

    import requests
    import streamlit as st

    api_url = os.environ.get("API_URL", "http://localhost:8000")
    st.set_page_config(page_title="hybridsearch_tpu_torch", layout="wide")
    st.title("hybridsearch_tpu_torch")
    tab_search, tab_index, tab_stats = st.tabs(["Search", "Index", "Stats"])

    with tab_search:
        query = st.text_input("Query")
        sw = st.slider("Semantic weight", 0.0, 1.0, 0.7, 0.05)
        if st.button("Search") and query:
            resp = requests.post(f"{api_url}/search", json={
                "query": query, "top_k": 10,
                "semantic_weight": sw, "lexical_weight": round(1 - sw, 4),
            }, timeout=60).json()
            for r in resp.get("results", []):
                col1, col2, col3 = st.columns([8, 1, 1])
                col1.write(f"**{r['score']:.4f}** — {r['content']}")
                if col2.button("👍", key=f"up{r['doc_id']}"):
                    requests.post(f"{api_url}/feedback", json={
                        "query": query, "doc_id": r["doc_id"], "rating": 1,
                    }, timeout=10)
                if col3.button("👎", key=f"dn{r['doc_id']}"):
                    requests.post(f"{api_url}/feedback", json={
                        "query": query, "doc_id": r["doc_id"], "rating": -1,
                    }, timeout=10)

    with tab_index:
        doc = st.text_area("Document text")
        if st.button("Add document") and doc:
            st.json(requests.post(f"{api_url}/index/add",
                                  json={"documents": [doc]}, timeout=120).json())
        directory = st.text_input("Directory to index / watch")
        c1, c2, c3 = st.columns(3)
        if c1.button("Index directory") and directory:
            st.json(requests.post(f"{api_url}/index/directory",
                                  json={"directory": directory}, timeout=600).json())
        if c2.button("Start watcher") and directory:
            st.json(requests.post(f"{api_url}/watcher/start",
                                  json={"directory": directory}, timeout=10).json())
        if c3.button("Stop watcher"):
            st.json(requests.post(f"{api_url}/watcher/stop", json={},
                                  timeout=10).json())

    with tab_stats:
        st.json(requests.get(f"{api_url}/stats", timeout=30).json())
        st.json(requests.get(f"{api_url}/cache/stats", timeout=30).json())


if __name__ == "__main__":  # pragma: no cover
    streamlit_app()
